"""FLoRIST server side: the SVD pipeline, the aggregators, the round
runtime and the federated trainer."""
