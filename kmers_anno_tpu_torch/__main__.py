"""``python -m kmers_anno_tpu_torch <command> ...`` — the App.main
equivalent of the port."""

import sys

from .commands.app import main

if __name__ == "__main__":
    sys.exit(main())
