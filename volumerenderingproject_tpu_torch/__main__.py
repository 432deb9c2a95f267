import sys

from .harness.cli import main

sys.exit(main())
