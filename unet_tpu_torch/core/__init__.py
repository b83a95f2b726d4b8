"""Host-side support of the port: pipeline configs as YAML, with the two
legacy layouts (config), and tracing and stage timing (profiling)."""
