"""The language-model scaffolding on one device: every model family's
forward pass, prefill with caches and cached decode (``registry`` maps
``--arch`` ids onto configs and these functions)."""
