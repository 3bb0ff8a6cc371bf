"""Port: ops/_cuda.py's reading of nvcc -Xptxas -v's report, on a canned
build log (no nvcc). Its lines are copied from a build on an NVIDIA H100
machine (CUDA 12.8) of the attention backward as it stood before its
warpgroup index was broadcast (pk_bwd_bf16 carries ptxas's note that its
wgmma instructions are serialized) and of the bf16 attention forward and the
add+LN backward (no note; the backward's NV=4 instantiation spilled). ptxas
prints the note before the entry function it names is compiled, so the
note must land under the function it names, not under the one whose
report precedes it."""

import pytest

from owlvit_tpu_torch.ops import _cuda

BWD = ("_ZN55_GLOBAL__N__f3a6ed1b_22_flash_attention_bwd_cu_cda7e02e11pk_bwd_bf16"
       "EPK13__nv_bfloat16S2_S2_S2_PKfS4_PfPS0_S6_iiif")
DELTA = ("_ZN55_GLOBAL__N__f3a6ed1b_22_flash_attention_bwd_cu_cda7e02e17pk_bwd_delta_bf16"
         "EPK13__nv_bfloat16S2_Pfiix")
DELTA_F32 = ("_ZN55_GLOBAL__N__f3a6ed1b_22_flash_attention_bwd_cu_cda7e02e12pk_bwd_deltaIfEEv"
             "PKT_S3_Pfiix")
FWD = ("_ZN55_GLOBAL__N__6837af0d_22_flash_attention_fwd_cu_caae48f211pk_fwd_bf16ILb0EEEv"
       "PK13__nv_bfloat16S3_S3_PS1_Pfiiiff")
LN_BWD = ("_ZN44_GLOBAL__N__305f8fb9_11_fused_ln_cu_1c2ae5c317add_ln_bwd_kernelI13__nv_bfloat16"
          "Li4EEEvPKT_S4_S4_PKfPS2_PfS8_if")
NOTE = ("(C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized "
        "due to program dependence on compiler-inserted WG.AR in divergent path in the "
        f"function '{BWD}'")

LOG = f"""== flash_attention_bwd.cu
ptxas info    : (C7519) warpgroup.arrive is injected in around line 4087 by compiler to allow use of registers in GMMA in function '{BWD}'
ptxas info    : {NOTE}
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{DELTA_F32}' for 'sm_90a'
ptxas info    : Function properties for {DELTA_F32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
ptxas info    : Compile time = 21.891 ms
ptxas info    : Compiling entry function '{BWD}' for 'sm_90a'
ptxas info    : Function properties for {BWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compile time = 264.718 ms
ptxas info    : Compiling entry function '{DELTA}' for 'sm_90a'
ptxas info    : Function properties for {DELTA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
ptxas info    : Compile time = 21.603 ms

== flash_attention_fwd.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers

== fused_ln.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{LN_BWD}' for 'sm_90a'
ptxas info    : Function properties for {LN_BWD}
    280 bytes stack frame, 788 bytes spill stores, 792 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 280 bytes cumulative stack size
"""


@pytest.fixture
def report(tmp_path):
    lib = tmp_path / "libowlvit_kernels_0123456789abcdef.so"
    lib.with_suffix(".log").write_text(LOG)
    return _cuda.ptxas_report(lib)


def test_every_entry_function_is_reported(report):
    assert set(report) == {DELTA_F32, BWD, DELTA, FWD, LN_BWD}


def test_note_lands_under_the_function_it_names(report):
    assert report[BWD] == [NOTE, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                           "Used 128 registers, used 1 barriers"]
    assert _cuda.wgmma_serialized(report[BWD])


@pytest.mark.parametrize("name, registers", [(DELTA_F32, 30), (DELTA, 24), (FWD, 106)])
def test_functions_without_the_note(report, name, registers):
    assert report[name] == ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                            f"Used {registers} registers, used {0 if 'delta' in name else 1} "
                            "barriers"]
    assert not _cuda.wgmma_serialized(report[name])


def test_spills_and_registers_of_the_add_ln_backward(report):
    assert report[LN_BWD] == [
        "280 bytes stack frame, 788 bytes spill stores, 792 bytes spill loads",
        "Used 128 registers, used 1 barriers, 280 bytes cumulative stack size"]
    assert not _cuda.wgmma_serialized(report[LN_BWD])


def test_other_ptxas_notes_are_not_serialisation():
    """C7519 (an injected warpgroup.arrive) names GMMA but says nothing is
    serialized."""
    line = LOG.splitlines()[1]
    assert "C7519" in line and not _cuda.wgmma_serialized([line])
