"""Ensemble parallelism: Monte-Carlo ensembles of E systems stepped together
on one device (``parallel.ensemble``). The multi-device mesh and ring of the
JAX package are ROADMAP.md queue A item A.15."""
