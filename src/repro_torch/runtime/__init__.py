"""Training runtime (twin of the single-device half of ``repro.runtime``):
MIP2Q gradient compression with error feedback, and fault tolerance."""
