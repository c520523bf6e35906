"""The epoch-loop engines and the reference-compatible driver API."""
