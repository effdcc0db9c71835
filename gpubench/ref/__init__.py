"""The benchmark's plain reference: the codecs and the develop model, from
the benchmark's own inputs. It imports nothing of the program
(``mcraw_torch``), of the JAX package or of JAX."""
