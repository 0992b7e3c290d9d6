"""Command-line entry points: ``train`` (the training driver, with the RNS
gradient all-reduce) and ``serve`` (the crypto family of the serve CLI);
the rest of serving comes with its slice."""
