"""Data: gensort records, the valsort gate, and the token pipeline with
its exoshuffle epoch shuffle."""
