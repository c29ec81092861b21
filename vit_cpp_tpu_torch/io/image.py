"""Host-side image decode: the port's counterpart of vit_cpp_tpu/io/image.py.

The native C++ decoder (vit_cpp_tpu_torch/native) is tried once per
process (decode.py) and PIL covers any format it rejects; both return the
same (H, W, 3) uint8 RGB layout as the reference's stb_image decode
(load_image_from_file, vit.cpp:109-127).
"""

from __future__ import annotations

import numpy as np

from vit_cpp_tpu_torch.decode import decode_file

# formats some decoder in the chain can read: native decode handles
# jpg/png/bmp/pnm, the PIL retry covers gif/tga/webp; used by the
# finetune dataset walk
IMAGE_EXTS = {
    ".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".pgm", ".pnm", ".gif",
    ".tga", ".webp", ".JPEG", ".JPG", ".PNG", ".BMP",
}


def load_image_rgb(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB; raises OSError if no
    decoder reads it."""
    img = decode_file(path)
    if img is None:
        raise OSError(f"{path}: cannot decode image")
    return img
