"""Parameter trees of the model, in the Flax names and (in, out) layout."""
