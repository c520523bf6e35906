"""Config, the epoch function and the named versions."""
