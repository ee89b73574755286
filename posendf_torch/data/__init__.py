"""Training data: the AMASS split table, synthetic datasets and the batcher."""
