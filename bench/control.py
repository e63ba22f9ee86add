"""A run of one cell with the judge's control in the program's place.

    python3 bench/control.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``bench/run.py`` does (the same set-up, window and
sample) with the control in the program's place: the reference with its
matmuls in fp8 (``bench/harness/judge.py``), a step below the bfloat16
the configuration serves in, and its first choice at each served
position held to the cell's limit.  So the run reports ``correct``
false; ``info.judge`` keeps both readings, the program's
(``max_logit_gap``) and the control's (``control_max_logit_gap``).  The
limit is set between the two: above the largest program reading over a
dozen seeds or more and below the smallest control reading.  The
benchmark's own runs never run this.
"""
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from bench import run  # noqa: E402


if __name__ == "__main__":
    sys.exit(run.main(control=True))
