"""``python3 -m aligntools_tpu_torch ...``: the port's CLI (``global``,
``local``, ``fit``, ``overlap``, ``edit``, ``batch``, ``serve``), for hosts
where the console script is not installed."""

import sys

from aligntools_tpu_torch.cli import main

sys.exit(main())
