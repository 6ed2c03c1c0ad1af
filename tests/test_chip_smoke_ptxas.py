"""chip_smoke.py's reading of nvcc's -Xptxas -v log: the register kernels'
registers, and a failure where one spills or is missing."""
import pytest

import chip_smoke

_ENTRY = """\
ptxas info    : Compiling entry function '{m}' for 'sm_90a'
ptxas info    : Function properties for {m}
    0 bytes stack frame, {st} bytes spill stores, {ld} bytes spill loads
ptxas info    : Used {r} registers, used 1 barriers
"""


def _mangled(kernel):
    ns = "_GLOBAL__N__cd4a514d_17_fused_step_odd_cu_93936618"
    return f"_ZN{len(ns)}{ns}{len(kernel)}{kernel}ILi31EJLi11ELi3EEEEvP6float2"


def _log(spill=None, drop=None):
    out = "--- fused_step_odd.cu\n"
    for i, (key, kern) in enumerate(chip_smoke.REG_KERNELS.items()):
        if key == drop:
            continue
        st = 8 if key == spill else 0
        out += _ENTRY.format(m=_mangled(kern), st=st, ld=st, r=160 + i)
    out += _ENTRY.format(m=_mangled("row_pass_kernel"), st=4, ld=4, r=90)
    return out


def test_register_engines_reads_the_registers():
    assert chip_smoke.register_engines(_log()) == {
        key: {"registers": [160 + i], "spill_bytes": 0}
        for i, key in enumerate(chip_smoke.REG_KERNELS)}


@pytest.mark.parametrize("key", sorted(chip_smoke.REG_KERNELS))
@pytest.mark.parametrize("fault", ["spill", "drop"])
def test_register_engines_fails_on_a_spill_or_a_missing_kernel(key, fault):
    with pytest.raises(SystemExit, match=chip_smoke.REG_KERNELS[key]):
        chip_smoke.register_engines(_log(**{fault: key}))
