"""Batched language-model serving: prefill, then a greedy or sampled
decode loop (``engine.generate``)."""
