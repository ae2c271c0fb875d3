"""CLI main for subavg."""
from .runner import main

if __name__ == "__main__":
    main(algo="subavg")
