"""Port of the corresponding vidsum_tpu subpackage."""
