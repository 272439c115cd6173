"""Iterative inference over the latents: Adam, method specs, the engine and
the bits-back engine."""
