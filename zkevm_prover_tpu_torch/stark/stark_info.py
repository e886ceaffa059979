"""StarkInfo — the reference's *.starkinfo.json schema.

Copy of `zkevm_prover_tpu/stark/stark_info.py` (stdlib only).

Reference: src/starkpil/stark_info.{hpp,cpp} (StarkInfo::load at
stark_info.cpp:21): starkStruct {nBits, nBitsExt, nQueries,
verificationHashType, steps[].nBits}, section widths (mapSectionsN), the
memory map (mapTotalN / mapOffsets), expression ids (qDeg/qDim), the opening
map evMap, and the argument contexts puCtx/peCtx/ciCtx.

This framework generates its own plan from an AIR (stark/setup.py), but the
schema is kept load/save-compatible so pil-stark setup artifacts can drive
the prover and our setups can be inspected with reference tooling.
"""

from __future__ import annotations

import dataclasses
import json

SECTIONS = ("cm1_n", "cm1_2ns", "cm2_n", "cm2_2ns", "cm3_n", "cm3_2ns",
            "cm4_2ns", "tmpExp_n", "q_2ns", "f_2ns")


@dataclasses.dataclass
class StarkStruct:
    nBits: int
    nBitsExt: int
    nQueries: int
    verificationHashType: str = "GL"
    steps: list = dataclasses.field(default_factory=list)  # [{"nBits": b}]


@dataclasses.dataclass
class EvMapEntry:
    type: str   # "cm" | "const" | "q"
    id: int
    prime: bool = False


@dataclasses.dataclass
class StarkInfo:
    starkStruct: StarkStruct
    nConstants: int = 0
    nPublics: int = 0
    nCm1: int = 0
    nCm2: int = 0
    nCm3: int = 0
    nCm4: int = 0
    qDeg: int = 1
    qDim: int = 3
    evMap: list = dataclasses.field(default_factory=list)
    mapSectionsN: dict = dataclasses.field(default_factory=dict)
    mapOffsets: dict = dataclasses.field(default_factory=dict)
    mapTotalN: int = 0

    @classmethod
    def load(cls, path_or_dict) -> "StarkInfo":
        d = path_or_dict
        if isinstance(d, str):
            with open(d) as f:
                d = json.load(f)
        ss = d["starkStruct"]
        struct = StarkStruct(
            nBits=ss["nBits"], nBitsExt=ss["nBitsExt"],
            nQueries=ss["nQueries"],
            verificationHashType=ss.get("verificationHashType", "GL"),
            steps=list(ss.get("steps", [])),
        )
        ev = [
            EvMapEntry(e["type"], e["id"], bool(e.get("prime", False)))
            for e in d.get("evMap", [])
        ]
        info = cls(
            starkStruct=struct,
            nConstants=d.get("nConstants", 0),
            nPublics=d.get("nPublics", 0),
            nCm1=d.get("nCm1", d.get("mapSectionsN", {}).get("cm1_n", 0)),
            nCm2=d.get("nCm2", d.get("mapSectionsN", {}).get("cm2_n", 0)),
            nCm3=d.get("nCm3", d.get("mapSectionsN", {}).get("cm3_n", 0)),
            nCm4=d.get("nCm4", d.get("mapSectionsN", {}).get("cm4_2ns", 0)),
            qDeg=d.get("qDeg", 1),
            qDim=d.get("qDim", 3),
            evMap=ev,
            mapSectionsN=dict(d.get("mapSectionsN", {})),
            mapOffsets=dict(d.get("mapOffsets", {})),
            mapTotalN=d.get("mapTotalN", 0),
        )
        if not info.mapSectionsN:
            info.compute_memory_map()
        return info

    def compute_memory_map(self) -> None:
        """Rebuild mapSectionsN/mapOffsets/mapTotalN the way the reference
        lays out its single arena (stark_info.cpp:58-104): section sizes in
        field elements, offsets accumulated in SECTIONS order."""
        n = 1 << self.starkStruct.nBits
        n_ext = 1 << self.starkStruct.nBitsExt
        widths = {
            "cm1_n": self.nCm1, "cm1_2ns": self.nCm1,
            "cm2_n": self.nCm2, "cm2_2ns": self.nCm2,
            "cm3_n": self.nCm3, "cm3_2ns": self.nCm3,
            "cm4_2ns": self.nCm4, "tmpExp_n": 0,
            "q_2ns": self.qDeg * self.qDim, "f_2ns": 3,
        }
        self.mapSectionsN = widths
        off = 0
        self.mapOffsets = {}
        for sec in SECTIONS:
            self.mapOffsets[sec] = off
            dom = n if sec.endswith("_n") else n_ext
            off += widths.get(sec, 0) * dom
        self.mapTotalN = off

    def save(self, path: str | None = None) -> dict:
        d = {
            "starkStruct": dataclasses.asdict(self.starkStruct),
            "nConstants": self.nConstants,
            "nPublics": self.nPublics,
            "nCm1": self.nCm1, "nCm2": self.nCm2,
            "nCm3": self.nCm3, "nCm4": self.nCm4,
            "qDeg": self.qDeg, "qDim": self.qDim,
            "evMap": [dataclasses.asdict(e) for e in self.evMap],
            "mapSectionsN": self.mapSectionsN,
            "mapOffsets": self.mapOffsets,
            "mapTotalN": self.mapTotalN,
        }
        if path:
            with open(path, "w") as f:
                json.dump(d, f, indent=1)
        return d

    @classmethod
    def from_setup(cls, setup) -> "StarkInfo":
        """Bridge from this framework's StarkSetup plan."""
        d = setup.describe()
        info = cls.load({**d, "evMap": d["evMap"]})
        return info
