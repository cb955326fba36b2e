"""``python -m bootstrapper_torch <command>``: the port's ``bs`` command
line (``cli/main.py``), the same entry as the ``bs-torch`` script.

``main(argv)`` runs one command and returns its exit code without leaving
the interpreter; ``doctor()`` is the environment report as a dict
(``cli/doctor.py``).
"""

from __future__ import annotations

import sys

from .cli.doctor import doctor
from .cli.main import main

__all__ = ["doctor", "main"]

if __name__ == "__main__":
    sys.exit(main(standalone_mode=True))
