"""Fork dispatch — map a batch's forkID to its ROM program.

Port of `zkevm_prover_tpu/executor/forks.py`.

Reference: src/main_sm/fork_N/ — the reference compiles one executor per
fork (9 copies of the main-SM source tree, selected in prover.cpp by
proverRequest.input.publicInputsExtended.publicInputs.forkID).  Here one
interpreter executes any fork's rom.json; the fork only selects the
program (and, for older forks, the input-schema variant).

Forks 7 (dragonfruit), 8 (elderberry) and 9 (etrog/feijoa line) ship
`scripts/rom.json` in the reference snapshot; forks 1-6 carry only the
PIL metadata (their ROMs are embedded in generated C++), so they load
only if the user supplies the JSON.
"""

from __future__ import annotations

import os

from .rom import Rom

# the reference checkout's main_sm tree, under the checkout that
# $ZKEVM_REFERENCE_ROOT names; None without it, and then no fork has a ROM
# unless the caller passes `root`
_CHECKOUT = os.environ.get("ZKEVM_REFERENCE_ROOT")
REFERENCE_ROOT = (os.path.join(_CHECKOUT, "src", "main_sm") if _CHECKOUT
                  else None)

_CACHE: dict[str, Rom] = {}


def rom_path(fork_id: int, root: str | None = REFERENCE_ROOT) -> str | None:
    if root is None:
        return None
    return os.path.join(root, f"fork_{fork_id}", "scripts", "rom.json")


def supported_forks(root: str | None = REFERENCE_ROOT) -> list[int]:
    return [f for f in range(1, 10)
            if root is not None and os.path.exists(rom_path(f, root))]


def rom_for_fork(fork_id: int, root: str | None = REFERENCE_ROOT) -> Rom:
    """Load (and cache) the ROM for a fork; raises if its rom.json is not
    available in the reference tree (or no tree is named)."""
    path = rom_path(fork_id, root)
    if path not in _CACHE:
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(
                f"fork {fork_id}: no rom.json at {path} (set "
                f"$ZKEVM_REFERENCE_ROOT or pass root=; forks with ROMs: "
                f"{supported_forks(root)})")
        _CACHE[path] = Rom.from_json(path)
    return _CACHE[path]
