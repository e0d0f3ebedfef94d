"""Supervised, unsupervised and prototype-contrastive losses."""
