"""Frame sources."""
