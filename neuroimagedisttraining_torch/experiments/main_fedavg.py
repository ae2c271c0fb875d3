"""CLI main for fedavg."""
from .runner import main

if __name__ == "__main__":
    main(algo="fedavg")
