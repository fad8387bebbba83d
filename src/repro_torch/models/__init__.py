"""Model pieces of the port: the config dataclasses and, so far, the
Mixture-of-Experts layer (``moe``) with its dropless block-sparse path."""
