"""Image quality metrics and RD result files."""
