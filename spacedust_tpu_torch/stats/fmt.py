"""C-compatible number formatting for output parity.

  * double -> "%.3E"   (sprintf in besthitbyset.cpp:129, combinehits.cpp:220,
                        Matcher.cpp resultToBuffer:288; SSTR(double) via
                        fmt::format("{:.3E}"), lib/mmseqs/src/commons/Util.cpp:658-661)
  * float  -> "%.3f"   (SSTR(float), Util.cpp:667-670)
  * seqId  -> fastSeqIdToBuffer (Util.cpp:222-251): "1.000" exactly for 1.0,
              otherwise "0." + int(seqId*1000) with leading-zero padding.

Python's '%.3E' matches C's printf %.3E for doubles (round-half-to-even at
the ULP level is identical since both use the same IEEE-754 shortest-digit
conversion for fixed precision).
"""

from __future__ import annotations

import numpy as np


def fmt_double_3e(x: float) -> str:
    return "%.3E" % float(x)


def fmt_float_3f(x: float) -> str:
    return "%.3f" % np.float32(x)


def fmt_seq_id(seq_id: float) -> str:
    """fastSeqIdToBuffer. `seq_id` must be the float32 value.

    NB for 1.0 the reference emits "1.00": fastSeqIdToBuffer writes
    "1.000" without advancing past the NUL, and resultToBuffer's
    `*(tmpBuff-1) = '\\t'` (Matcher.cpp:287) overwrites the final '0'.
    """
    s = np.float32(seq_id)
    if s == np.float32(1.0):
        return "1.00"
    out = "0."
    if s < np.float32(0.10):
        out += "0"
    if s < np.float32(0.01):
        out += "0"
    return out + str(int(s * np.float32(1000)))
