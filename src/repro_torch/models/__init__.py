"""The LM scaffold's models (``repro.models``'s counterpart): the config,
layers, attention, KV cache and the dense transformer's prefill and decode."""
