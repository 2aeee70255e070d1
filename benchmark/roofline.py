"""The least time a kernel's work could take on the card (a frozen copy
of the arithmetic the program's smoke test keeps, recounted so that it
depends on the inputs alone, not on the implementation).

The extraction reads each input base once, at 2 bits, and writes each
valid k-mer window once as its W 32-bit words: the bytes a job needs,
whatever the kernel pads, repeats or widens.  Its least time is those
bytes over the card's memory bandwidth (`peaks.json`).  The integer
operations of a window are not counted: they depend on how the k-mer is
built, and leaving them out only lowers the bound.
"""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named `kind` (None if unknown)."""
    with open(PEAKS_FILE) as f:
        return json.load(f).get(kind)


def extract_bytes(bases: int, windows: int, W: int) -> int:
    """Bytes the extraction of `bases` input bases into `windows` valid
    k-mers of W words needs: 2 bits a base in, 4 W bytes a k-mer out."""
    return bases // 4 + windows * 4 * W
