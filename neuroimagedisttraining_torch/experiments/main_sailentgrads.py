"""CLI main for salientgrads, under the original's own spelling of the file
name (``main_sailentgrads.py``)."""
from .runner import main

if __name__ == "__main__":
    main(algo="salientgrads")
