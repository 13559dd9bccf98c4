"""``python -m repro_torch.analysis [--gate] [paths ...]``: the port's
repro-lint CLI (exit codes in :mod:`repro_torch.analysis.driver`)."""
import os
import sys

from .driver import main

if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:            # e.g. `... --rules | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
