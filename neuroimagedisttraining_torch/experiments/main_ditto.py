"""CLI main for ditto."""
from .runner import main

if __name__ == "__main__":
    main(algo="ditto")
