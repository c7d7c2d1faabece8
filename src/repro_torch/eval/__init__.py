"""Evaluation harnesses of the port (counterpart of ``repro.eval``): the
Monte-Carlo cell-variation robustness sweep."""
