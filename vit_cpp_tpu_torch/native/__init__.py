# Native host-side image decoder (C++, libjpeg/libpng), the port's own copy
# of vit_cpp_tpu/native. `decoder` builds the shared library on first import;
# vit_cpp_tpu_torch/decode.py loads it once per process and falls back to PIL.
