"""``python -m fastqdedup_tpu_torch`` entry point
(reference __main__.py:17-20)."""

from .cli import main

if __name__ == "__main__":
    main()
