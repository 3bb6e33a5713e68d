"""Frame I/O (the reference CSV format) and decisions-log export."""
