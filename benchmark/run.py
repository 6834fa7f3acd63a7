#!/usr/bin/env python3
"""Entry point of the port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout (``BENCHMARK.json`` names the cells).
Prints one JSON object as the last line of standard output; exits
non-zero, printing no result, without enough CUDA devices.
"""

import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

# every cache of the program and of its libraries at a fixed path inside
# the checkout (the kernels build into build/kernels, the native
# libraries into build/native, both of the checkout already)
_CACHE = os.path.join(ROOT, "build", "bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
# one host thread for torch's CPU ops: the cells are bound by the host's
# one dispatching thread, and idle pool threads only contend with it
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from benchmark.core.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
