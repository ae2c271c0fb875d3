"""CLI main for fedfomo."""
from .runner import main

if __name__ == "__main__":
    main(algo="fedfomo")
