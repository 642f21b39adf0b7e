"""UniPC sampling and the decode pipeline."""
