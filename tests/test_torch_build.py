"""The kernel build helper's report of registers and spills.

``repro_torch.kernels._build`` compiles every kernel with ``-Xptxas -v``
and keeps the compiler's output; ``ptxas_usage`` reads each entry's
registers and spill bytes from it.  No compiler is needed here: the
input is ptxas's own wording.
"""
from __future__ import annotations

from repro_torch.kernels import _build

FA, SM = "_ZN1a22flash_attention_kernelIfLi128EEEv", "_ZN1b13sm_f32_kernelEv"
REPORT = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FA}' for 'sm_90a'
ptxas info    : Function properties for {FA}
    56 bytes stack frame, 56 bytes spill stores, 80 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 56 bytes cumulative
ptxas info    : Compiling entry function '{SM}' for 'sm_90a'
ptxas info    : Function properties for {SM}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 33280 bytes smem
"""


def test_ptxas_usage_reads_each_entry():
    assert _build.ptxas_usage(REPORT) == {
        FA: dict(registers=255, spill_stores=56, spill_loads=80),
        SM: dict(registers=128, spill_stores=0, spill_loads=0)}


def test_ptxas_usage_of_no_report_is_empty():
    assert _build.ptxas_usage("") == {}


def test_builds_ask_ptxas_for_its_report():
    flags = list(_build.NVCC_FLAGS)
    assert flags[flags.index("-Xptxas") + 1] == "-v"
