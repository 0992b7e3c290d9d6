"""Configurations of the port: the paper's own RNS bases (paper_rns)."""
