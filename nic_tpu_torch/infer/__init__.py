"""Iterative inference over the latents: Adam, method specs and the engine."""
