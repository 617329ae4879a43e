"""System facade and bank conversion from the JAX package."""
