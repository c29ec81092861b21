"""The static-scale sidecar: JSON scales beside a gguf, read by
`VitEngine(act_scales=...)` and the CLIs' `--act-scales`.

Counterpart of save_act_scales / load_act_scales of
vit_cpp_tpu/quant/qat.py (:301-331), which write and read the same file.
Quantization-aware training itself (fake-quant forward, `--qat`,
`--qat-act`) is not ported yet: it comes with the training-extras slice.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

_GEMMS = ("qkv", "proj", "fc1", "fc2")


def save_act_scales(path: str, scales: Dict[str, torch.Tensor], margin: float) -> None:
    """Write per-site scales (absmax * margin / 127) as the sidecar JSON:
    {"margin", "rule", <site>: [floats]}."""
    payload = {"margin": margin, "rule": "absmax*margin/127"}
    for k, v in scales.items():
        payload[k] = torch.as_tensor(v).detach().float().cpu().reshape(-1).tolist()
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def load_act_scales(path: str) -> Dict[str, torch.Tensor]:
    """Read a sidecar back to the calibrator's shapes: (L, 1, 1) f32 per
    block site, (1, 1) for the head when present."""
    with open(path) as f:
        payload = json.load(f)
    out: Dict[str, torch.Tensor] = {}
    for name in _GEMMS:
        if name not in payload:
            raise ValueError(f"act-scales file {path} is missing {name!r}")
        v = torch.tensor(payload[name], dtype=torch.float32)
        out[name] = v.reshape(v.shape[0], 1, 1)
    if "head" in payload:
        out["head"] = torch.tensor(payload["head"], dtype=torch.float32).reshape(1, 1)
    return out
