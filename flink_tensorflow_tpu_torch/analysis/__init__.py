"""Plan-time passes over the dataflow graph (operator chaining)."""
