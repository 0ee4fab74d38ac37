"""``python -m gfdm_bench``: one run of one benchmark cell (see run.py)."""
import sys

from gfdm_bench.run import main

if __name__ == "__main__":
    sys.exit(main())
