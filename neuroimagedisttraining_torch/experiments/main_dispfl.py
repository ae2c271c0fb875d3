"""CLI main for dispfl."""
from .runner import main

if __name__ == "__main__":
    main(algo="dispfl")
