"""AP helpers from the reference ``core/apfloat.py``.

Port note: only :func:`_tag_ge` is ported so far — it is all the
Black-Scholes workload imports.  The bit-serial IEEE-754 routines follow
with the rest of the AP machine (ROADMAP Queue 1, item 1).
"""
from __future__ import annotations

from repro_torch.core.bitplane import Field
from repro_torch.core.engine import APEngine


def _tag_ge(eng: APEngine, f: Field, const: int, out_col: Field) -> None:
    """out_col <- (f >= const) for an 8-bit field, via tagged compares."""
    # tag rows where f >= const by enumerating matching prefixes (MSB logic):
    # f >= c iff for some bit position i: f[hi..i+1]==c[hi..i+1], f_i=1, c_i=0,
    # or f == c.
    m = f.width
    cbits = [(const >> i) & 1 for i in range(m)]
    for i in range(m):
        if cbits[i] == 0:
            cols = [f.col(j) for j in range(i, m)]
            key = [1] + [cbits[j] for j in range(i + 1, m)]
            eng.compare(cols, key)
            eng.write([out_col.col(0)], [1])
    eng.compare(f.cols(), cbits)
    eng.write([out_col.col(0)], [1])
