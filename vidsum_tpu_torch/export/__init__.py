# ported from vidsum_tpu/export/__init__.py
"""Port of the corresponding vidsum_tpu subpackage (the summary JSON export;
the frame and attention exports arrive with the preprocess slice)."""
