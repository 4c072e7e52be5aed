"""``python -m futbench``: see :mod:`futbench.run`."""

import time

_START = time.time()

import sys  # noqa: E402

from futbench.run import main  # noqa: E402

sys.exit(main(start=_START))
