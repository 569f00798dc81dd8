"""End-to-end counting pipelines of the port."""
