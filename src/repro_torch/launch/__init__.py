"""Command-line entry points.  For now ``serve`` (the crypto family of the serve
CLI); training and the rest of serving come with their slices."""
