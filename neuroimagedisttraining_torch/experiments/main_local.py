"""CLI main for local."""
from .runner import main

if __name__ == "__main__":
    main(algo="local")
