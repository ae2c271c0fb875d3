"""CLI main for turboaggregate."""
from .runner import main

if __name__ == "__main__":
    main(algo="turboaggregate")
