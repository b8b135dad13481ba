"""Sort engines (XLA argsort, jnp counting / LSD cross-checks) and the
u32 word codecs of the distributed sort."""
