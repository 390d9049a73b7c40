#!/usr/bin/env python3
"""Time pass 1 of the PyTorch port on one CUDA card, route by route.

Usage: python3 scripts/pass1_probe.py      (from the root of a checkout)

Compresses the Silesia-like corpus into the 17 L6 items of 1 MiB, as
`chip_smoke.py` does, then runs its pass-1 route phase on those items
(out_cap 1 MiB) and on the 256 zlib-6 streams of 64 KiB slices (out_cap
64 KiB): the segment route and the serial route (sync stops off), held
equal and timed by CUDA events in turns, with the byte bound, peak
memory and the route's counts.
It is the quick measurement of a pass-1 change; `chip_smoke.py` holds the
kernels to their plain versions.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pass1_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_card()
    cs.phase_build()
    data = cs.corpus()
    _, comp = cs.phase_compress(data)
    cs.phase_pass1_routes(comp, cs.ITEM,
                          f"the {len(comp)} L6 items (out_cap 1 MiB)")
    slices = [cs.raw_z(data[i * cs.SLICE:(i + 1) * cs.SLICE])
              for i in range(cs.N_SLICES)]
    cs.phase_pass1_routes(slices, cs.SLICE,
                          f"the {cs.N_SLICES} zlib-6 slices (out_cap 64 KiB)")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
