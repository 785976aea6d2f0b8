"""Federated-learning layer of the port: registries, adapters, client
training, the per-window engine, callbacks and the declarative API."""
