"""``python -m bootstrapper_torch.cli``: the same entry as the ``bs-torch``
script and ``python -m bootstrapper_torch``."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main(standalone_mode=True))
