"""Observability utilities copied from the JAX package (metrics JSONL
logs, the telemetry event bus, tracing spans) plus the port's device
resolution.  Submodules are imported where they are used."""
