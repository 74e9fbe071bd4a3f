"""Entry points: prefill and decode steps, and the batched server."""
