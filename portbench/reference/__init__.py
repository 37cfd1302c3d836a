"""The plain reference that decides `correct` (see `network.py`)."""
