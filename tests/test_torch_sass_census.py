"""The SASS census's pure string functions: kernel names from demangled
signatures, and registers and spills from ptxas's report."""

import pytest

from vit_cpp_tpu_torch.tools.sass_census import ptxas_usage, short_name

_ROWS = "_ZN54_GLOBAL__N__6030ce41_21_attention_qkv_grad_cu_711961de13grad_rows_mmaI13__nv_bfloat16Li8EEEvN4grad4ArgsIT_EE"
_MMA = "_ZN49_GLOBAL__N__fbb7978c_16_attention_qkv_cu_1af15f1113attention_mmaILi6EEEvPK13__nv_bfloat16S3_S3_N4attn7StridesEPKfPS1_S5_iiifi"

_REPORT = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_ROWS}' for 'sm_90a'
ptxas info    : Function properties for {_ROWS}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 152 registers, used 1 barriers
ptxas info    : Compile time = 200.492 ms
ptxas info    : Compiling entry function '{_MMA}' for 'sm_90a'
ptxas info    : Function properties for {_MMA}
    16 bytes stack frame, 16 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compile time = 543.421 ms
"""


@pytest.mark.parametrize("signature, name", [
    ("void (anonymous namespace)::attention_mma<4>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, attn::Strides, float const*, __nv_bfloat16*, attn::Strides, int, "
     "int, int, float, int)", "attention_mma<4>"),
    ("void (anonymous namespace)::grad_rows_mma<__nv_bfloat16, 4>(grad::Args<__nv_bfloat16>)",
     "grad_rows_mma<__nv_bfloat16, 4>"),
    ("void anatomy::anatomy_mma<0, 4, 16>(__nv_bfloat16 const*, attn::Strides, attn::Group)",
     "anatomy_mma<0, 4, 16>"),
    ("void _GLOBAL__N__6030ce41_21_attention_qkv_grad_cu_711961de::grad_cols_mma<float, 8>"
     "(grad::Args<float>)", "grad_cols_mma<float, 8>"),
    ("void <unnamed>::attention_mma<(int)4>(const __nv_bfloat16 *, const __nv_bfloat16 *, "
     "const __nv_bfloat16 *, attn::Strides, const float *, __nv_bfloat16 *, attn::Strides, int, "
     "int, int, float, int)", "attention_mma<4>"),
    ("void <unnamed>::grad_rows_mma<__nv_bfloat16, (int)4>(grad::Args<__nv_bfloat16>)",
     "grad_rows_mma<__nv_bfloat16, 4>"),
    ("void anatomy::anatomy_mma<(int)0, (int)4, (int)16>(const __nv_bfloat16 *, attn::Group)",
     "anatomy_mma<0, 4, 16>"),
    ("void <unnamed>::dot_kernel<signed char>(const signed char *, int *)",
     "dot_kernel<signed char>"),
    ("vit_probe_kernel", "vit_probe_kernel"),
])
def test_short_name(signature, name):
    assert short_name(signature) == name


def test_ptxas_usage():
    assert ptxas_usage(_REPORT) == {_ROWS: (152, 0, 0), _MMA: (128, 16, 44)}
