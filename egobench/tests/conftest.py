"""The benchmark's tests: `python -m pytest egobench/tests -q` from the
root of the checkout (the card's tests: add `-m gpu`)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
