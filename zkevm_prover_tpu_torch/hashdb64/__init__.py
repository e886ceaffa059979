"""HashDB64 — the file-backed paged state backend (native C++).

Counterpart of `zkevm_prover_tpu/hashdb64` (reference src/hashdb64:
"USE_NEW_KVTREE", 4 KB pages mmapped from page files,
page_manager.hpp:20-73). The page store is the port's own copy of
`native/pagestore.cpp`, compiled with g++ into the package's git-ignored
`build/` directory on first use (never at import) and bound with ctypes;
`Database64` adapts it to the interface the SMT consumes, so `Smt` runs
unchanged on either backend.
"""

from .page_store import PageStore, build_library
from .database64 import Database64

__all__ = ["PageStore", "Database64", "build_library"]
