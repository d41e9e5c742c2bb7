"""The port's LM stack: layers, attention, RG-LRU and the decoder model."""
