"""CLI main for dpsgd."""
from .runner import main

if __name__ == "__main__":
    main(algo="dpsgd")
