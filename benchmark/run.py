"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are those of `BENCHMARK.json` at the
root of the checkout; see `benchmark/f3sbench/core.py`.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the harness, then the program at the root of the checkout
sys.path[:0] = [str(HERE), str(HERE.parent)]

from f3sbench import core  # noqa: E402

if __name__ == "__main__":
    t_start = core.process_start()
    sys.exit(core.main(sys.argv[1:], t_start))
