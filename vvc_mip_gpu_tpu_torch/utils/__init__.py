"""Configuration, stage timing and the dispatch pipeline."""
