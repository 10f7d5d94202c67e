"""The LM scaffold's models (``repro.models``'s counterpart): the config,
layers, attention, MLA, MoE, the Mamba-2 and RG-LRU blocks, the decode cache
and the transformer's prefill and decode."""
