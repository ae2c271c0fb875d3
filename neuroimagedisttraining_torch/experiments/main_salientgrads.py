"""CLI main for salientgrads: the corrected-spelling alias of
``main_sailentgrads.py`` (the original file name is ``main_sailentgrads.py``,
sic)."""
from .runner import main

if __name__ == "__main__":
    main(algo="salientgrads")
