"""The SASS census's pure string functions: kernel names from demangled
signatures, registers and spills from ptxas's report, and opcodes and
tensor-core instructions by kind from cuobjdump's text; and the variant
tool's (tools/grad_variants.py) reading of ptxas's report."""

import pytest

from vit_cpp_tpu_torch.tools.grad_variants import parse_report
from vit_cpp_tpu_torch.tools.sass_census import parse_sass, ptxas_usage, short_name, tensor_ops

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
    ("void (anonymous namespace)::grad_rows_wgmma(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, gradwg::Params)", "grad_rows_wgmma"),
    ("void <unnamed>::grad_cols_wgmma(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "gradwg::Params)", "grad_cols_wgmma"),
    # K2's d = 80 kernels and K1's f32 wgmma body (d, fast, sizes)
    ("void (anonymous namespace)::grad_rows_wgmma80(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, gradwg::Params)", "grad_rows_wgmma80"),
    ("void <unnamed>::grad_cols_wgmma80(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "gradwg::Params)", "grad_cols_wgmma80"),
    ("void (anonymous namespace)::attention_tf32_wgmma<80, false, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, fwdwg::Params)", "attention_tf32_wgmma<80, false, true>"),
    ("void <unnamed>::attention_tf32_wgmma<(int)64, (bool)1, (bool)0>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, fwdwg::Params)", "attention_tf32_wgmma<64, 1, 0>"),
    # K2's bf16 body at d = 64 and T2's instantiations of it (variant, onedot)
    ("void (anonymous namespace)::grad_rows_bf16_wgmma(CUtensorMap_st, CUtensorMap_st, "
     "gradbf::Params)", "grad_rows_bf16_wgmma"),
    ("void <unnamed>::grad_cols_bf16_wgmma(CUtensorMap_st, CUtensorMap_st, gradbf::Params)",
     "grad_cols_bf16_wgmma"),
    ("void (anonymous namespace)::grad_rows_anatomy_wgmma<3>(CUtensorMap_st, CUtensorMap_st, "
     "gradbf::Params)", "grad_rows_anatomy_wgmma<3>"),
    ("void <unnamed>::grad_cols_anatomy_wgmma<(int)2>(CUtensorMap_st, CUtensorMap_st, "
     "gradbf::Params)", "grad_cols_anatomy_wgmma<2>"),
    ("void (anonymous namespace)::grad_onedot_wgmma(CUtensorMap_st, __nv_bfloat16*, int, int, "
     "float)", "grad_onedot_wgmma"),
    # K1's bf16 body at d = 64 and T1's instantiations of it (variant, NKS)
    ("void (anonymous namespace)::attention_wgmma<true, false>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, attn::WgCoords, float const*, int, int, float)",
     "attention_wgmma<true, false>"),
    # the same body at d = 80 and 88 (D, fast, sizes)
    ("void (anonymous namespace)::attention_wgmma_d<80, true, false>(attn::WgMaps, "
     "attn::WgCoords, float const*, int, int, float)", "attention_wgmma_d<80, true, false>"),
    ("void <unnamed>::attention_wgmma_d<(int)88, (bool)0, (bool)1>(attn::WgMaps, "
     "attn::WgCoords, const float *, int, int, float)", "attention_wgmma_d<88, 0, 1>"),
    ("void anatomy::anatomy_wgmma<0, 0>(CUtensorMap_st, CUtensorMap_st, attn::WgCoords, int, "
     "float, attn::Group, __nv_bfloat16*, long long)", "anatomy_wgmma<0, 0>"),
    ("void anatomy::anatomy_wgmma<(int)7, (int)8>(CUtensorMap_st, CUtensorMap_st, "
     "attn::WgCoords, int, float, attn::Group, __nv_bfloat16 *, long long)",
     "anatomy_wgmma<7, 8>"),
])
def test_short_name(signature, name):
    assert short_name(signature) == name


def test_ptxas_usage():
    assert ptxas_usage(_REPORT) == {_ROWS: (152, 0, 0), _MMA: (128, 16, 44)}


# cuobjdump -sass's text: one kernel of each tensor-core kind, guarded and
# unguarded instructions
_SASS = """
\tcode for sm_90a
\t\tFunction : _Z3wgmv
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                       /* 0x00000a0000017a02 */
        /*0010*/                   WARPGROUP.ARRIVE ;                            /* 0x00000000000079cd */
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8].tnspB, R24 ;  /* 0x41e00000081879f0 */
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8].tnspB, R24, gsb0 ;  /* 0x41e00000081879f0 */
        /*0040*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR12], R24, gsb0 ;  /* 0x41e000000c1879f0 */
        /*0050*/                   EXIT ;                                        /* 0x000000000000794d */
\t\t..........

\t\tFunction : _Z4syncv
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;        /* 0x0000000c0804723c */
        /*0010*/               @P0 HMMA.16816.F32.BF16 R16, R8, R14, R16 ;      /* 0x0000000e0810023c */
        /*0020*/                   IMMA.16832.S8.S8 R20, R8.ROW, R12.COL, R20 ;  /* 0x0000000c0814723c */
        /*0030*/                   EXIT ;                                        /* 0x000000000000794d */
"""


def test_parse_sass_counts_each_tensor_core_kind():
    ops = parse_sass(_SASS)
    assert set(ops) == {"_Z3wgmv", "_Z4syncv"}
    assert ops["_Z3wgmv"][:2] == ["MOV", "WARPGROUP.ARRIVE"] and len(ops["_Z3wgmv"]) == 6
    assert tensor_ops(ops["_Z3wgmv"]) == {"HGMMA": 2, "IGMMA": 1, "HMMA": 0, "IMMA": 0}
    assert tensor_ops(ops["_Z4syncv"]) == {"HGMMA": 0, "IGMMA": 0, "HMMA": 2, "IMMA": 1}


_NOTE = ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
         "serialized due to non wgmma instructions defining accumulator registers of a wgmma "
         f"between start and end of the pipeline stage in the function '{_ROWS}'\n")


def test_parse_report_reads_registers_spills_and_wgmma_notes():
    usage, notes = parse_report(_NOTE + _REPORT + _NOTE)
    assert usage == {_ROWS: (152, 0), _MMA: (128, 16)}
    assert notes == [("C7515", _ROWS)]
    assert parse_report(_REPORT) == ({_ROWS: (152, 0), _MMA: (128, 16)}, [])
