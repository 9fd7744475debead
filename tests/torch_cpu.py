"""CPU helpers for the port's tests.

`warm_intra_op_threads`: on an AVX-512 x86 virtual machine, the first
vectorized unary op (torch.sqrt, split into 2,048-element chunks across the
intra-op threads) of a fresh process has returned one chunk with a relative
error of ~3e-4 in 2 and 4 of 40 processes run eight at a time, and never on
a later call or after this warm-up.  A
test that holds the plain versions' eigenvalue clamp to 1e-5 runs one such
op first so that the comparison sees the correctly rounded results.

Usage: python tests/torch_cpu.py [processes]  counts, over fresh processes
run eight at a time, those whose first torch.sqrt of 14,336 elements is off
by more than 1e-6 relative, without and with the warm-up.
"""

import subprocess
import sys

import torch

_PROBE = """
import sys
import numpy as np
import torch
if sys.argv[1] == "warm":
    from tests.torch_cpu import warm_intra_op_threads
    warm_intra_op_threads()
a = np.random.default_rng(0).uniform(1e-4, 1e-2, 14336).astype(np.float32)
got = torch.sqrt(torch.as_tensor(a)).numpy()
ref = np.sqrt(a.astype(np.float64))
print(int((np.abs(got - ref) / ref).max() > 1e-6))
"""


def warm_intra_op_threads():
    for _ in range(2):
        torch.sqrt(torch.rand(1 << 16))


def main(n, concurrent=8):
    for mode in ("cold", "warm"):
        bad = 0
        for start in range(0, n, concurrent):
            procs = [subprocess.Popen([sys.executable, "-c", _PROBE, mode],
                                      stdout=subprocess.PIPE, text=True)
                     for _ in range(min(concurrent, n - start))]
            bad += sum(int(p.communicate()[0]) for p in procs)
        print(f"{mode}: {bad} of {n} fresh processes ({concurrent} at a time) had a "
              f"first sqrt off by > 1e-6")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 40)
