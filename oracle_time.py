"""Time the CLI's two golden oracles on the host.

    python3 oracle_time.py

On the inputs ``python -m plf_tpu_torch`` makes (``make_data``: the DNA
default at 2^24 sites, 20state at 2^21 sites), one call each of the
native golden oracle (``runtime/native.py``: g++ -O3, multithreaded; its
build is timed apart) and of the NumPy golden model
(``reference.plf_reference``), with whether the two agree bit for bit.
Prints one JSON line per shape.  Needs no GPU.
"""

import json
import os
import time

import numpy as np

from plf_tpu_torch.__main__ import make_data
from plf_tpu_torch.reference import plf_reference
from plf_tpu_torch.runtime.native import golden_oracle, plf_golden_native


def main():
    t0 = time.perf_counter()
    oracle = golden_oracle()
    print(json.dumps(dict(oracle=oracle, build_s=time.perf_counter() - t0,
                          cpus=os.cpu_count())), flush=True)
    for S, n in ((4, 1 << 24), (20, 1 << 21)):
        case = make_data(n, S, 4)
        t0 = time.perf_counter()
        nat = plf_golden_native(*case, states=S, categories=4)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = plf_reference(*case, states=S, categories=4)
        t_ref = time.perf_counter() - t0
        same = (np.array_equal(nat[0], ref[0]) and
                np.array_equal(nat[1], ref[1]) and nat[2] == ref[2])
        print(json.dumps(dict(states=S, sites=n, native_s=t_nat,
                              numpy_s=t_ref, bit_equal=bool(same))),
              flush=True)
        del case, nat, ref


if __name__ == "__main__":
    main()
