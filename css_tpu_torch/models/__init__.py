"""DeepLabV3+ with the dual classifier/representation head."""
