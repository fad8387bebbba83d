"""Published model configurations (copies of ``repro.configs`` modules,
ported one at a time with the slice that first runs them)."""
