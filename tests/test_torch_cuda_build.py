"""cuda_build.sass_counts on cuobjdump-shaped text: opcode classes, loops
and the guarded blocks that hold a loop; and kernel_ab's refusal without a
card (CPU; no toolkit needed)."""

from __future__ import annotations

import subprocess
import types

import pytest

from zkevm_prover_tpu_torch import cuda_build

# (address, predicate, instruction) of a kernel shaped like the Poseidon
# permutation: a rolled outer loop whose body holds a guarded block, and in
# it an inner loop
KERNEL = [
    (0x00, "", "LDC R1, c[0x0][0x28]"),
    (0x10, "", "IMAD.WIDE.U32 R28, R3, 0x80, R28"),
    (0x20, "", "ISETP.GE.U32.AND P0, PT, R28, UR4, PT"),
    (0x30, "@P0", "EXIT"),
    (0x40, "", "IMAD R0, R29, 0x60, RZ"),          # outer loop from here
    (0x50, "", "IADD3 R2, P1, R0, R4, RZ"),
    (0x60, "@!P2", "BRA 0xb0"),                    # guard: skips 0x70..0xa0
    (0x70, "", "IMAD.HI.U32 R5, R6, R7, RZ"),      # inner loop from here
    (0x80, "", "LOP3.LUT R5, R5, 0xff, RZ, 0xc0, !PT"),
    (0x90, "@P3", "BRA 0x70"),                     # inner back edge
    (0xa0, "", "NOP"),
    (0xb0, "", "SHF.R.U32.HI R8, RZ, 0x1, R9"),
    (0xc0, "@P4", "BRA 0x40"),                     # outer back edge
    (0xd0, "", "STG.E.64 desc[UR4][R2.64], R4"),
    (0xe0, "", "EXIT"),
    (0xf0, "", "BRA 0xf0"),                        # the trailing self-loop
]


def _sass(kernels: dict) -> str:
    text = ["", "Fatbin elf code:", "================"]
    for name, insts in kernels.items():
        text += [f"\t\tFunction : {name}",
                 '\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_SM90"']
        for addr, pred, inst in insts:
            text.append(f"        /*{addr:04x}*/ {pred:>18} {inst} ;"
                        f"{'':20}/* 0x000fc00000000000 */")
            text.append(f"{'':85}/* 0x000fc00000000000 */")
        text.append("\t\t..........")
    return "\n".join(text)


@pytest.fixture
def counts(monkeypatch):
    def run(kernels):
        out = types.SimpleNamespace(stdout=_sass(kernels))
        monkeypatch.setattr(cuda_build, "_tool", lambda name: name)
        monkeypatch.setattr(subprocess, "run", lambda *a, **k: out)
        return cuda_build.sass_counts("lib.so")
    return run


def test_sass_counts_classes(counts):
    got = counts({"k": KERNEL})["k"]["counts"]
    assert got["all"] == len(KERNEL) - 1          # the NOP is not counted
    assert got["IMAD"] == 3 and got["IMAD.WIDE"] == 1 and got["IMAD.HI"] == 1
    assert got["BRA"] == 4 and got["LDC"] == 1 and got["STG"] == 1
    assert got["op:EXIT"] == 2 and got["op:IMAD"] == 3


def test_sass_counts_loops_and_guarded_blocks(counts):
    info = counts({"k": KERNEL})["k"]
    spans = [loop[:3] for loop in info["loops"]]
    assert spans == [(7, 9, 3), (4, 12, 9), (15, 15, 1)]
    assert [g[:3] for g in info["guarded"]] == [(7, 10, 4)]
    inner = info["loops"][0][3]
    assert inner == {"all": 3, "op:IMAD": 1, "IMAD": 1, "IMAD.HI": 1,
                     "op:LOP3": 1, "LOP3": 1, "op:BRA": 1, "BRA": 1}


def test_sass_counts_keeps_only_guarded_blocks_with_a_loop(counts):
    kernel = KERNEL[:4] + [(0x40, "@P1", "BRA 0x60"),
                           (0x50, "", "IADD3 R2, P1, R0, R4, RZ"),
                           (0x60, "", "EXIT")]
    info = counts({"k": kernel})["k"]
    assert info["loops"] == [] and info["guarded"] == []


@pytest.mark.parametrize("names", [("a",), ("a", "b")])
def test_sass_counts_splits_kernels(counts, names):
    got = counts({n: KERNEL[:4] for n in names})
    assert list(got) == list(names)
    for n in names:
        assert got[n]["counts"]["all"] == 4
        assert got[n]["loops"] == [] and got[n]["guarded"] == []


def test_kernel_ab_needs_a_card(capsys):
    """The same-process A/B harness takes the poseidon_gl library's modes
    and exits nonzero, printing no time, where CUDA is absent."""
    import torch

    from zkevm_prover_tpu_torch import kernel_ab
    from zkevm_prover_tpu_torch.ops import poseidon_cuda

    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")
    with pytest.raises(SystemExit):
        kernel_ab.main(["mxu128", "lib.so"])   # not a poseidon_gl mode
    assert kernel_ab.main(["2d", "lib.so"]) == 2
    assert "ms" not in capsys.readouterr().out
    assert sorted(poseidon_cuda._GL_PERMUTE) == ["1d", "2d", "blocked",
                                                "mxu", "mxu24", "mxu96"]
