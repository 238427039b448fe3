"""CARD core: hashing, chunking, features, context model, index, delta,
detector."""
