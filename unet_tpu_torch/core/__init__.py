"""Host-side support of the port: pipeline configs as YAML, with the two
legacy layouts (config), tracing and stage timing (profiling), and
training checkpoints with their JSON sidecars (checkpoint)."""
