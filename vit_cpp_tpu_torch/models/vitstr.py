"""ViTSTR's vocabulary, for the converter's `--vitstr`.

The port's own copy of VITSTR_VOCAB and vitstr_id2label from
vit_cpp_tpu/models/vitstr.py (:36): the 96-token vocabulary
['[GO]', '[s]'] + string.printable[:-6] that a converted ViTSTR file
carries as its labels. The ViTSTR model itself (grayscale preprocessing,
the sequence readout, greedy decoding) is not ported yet: a 1-channel
checkpoint raises at engine.detect_hparams until the model-families
slice.
"""

from __future__ import annotations

import string
from typing import Dict, List

# id 0 = '[GO]' (start padding), id 1 = '[s]' (end of sequence).
VITSTR_VOCAB: List[str] = ["[GO]", "[s]"] + list(string.printable[:-6])


def vitstr_id2label() -> Dict[int, str]:
    return dict(enumerate(VITSTR_VOCAB))
