"""The plain reference: SILO's query semantics over the benchmark's corpus
arrays, in NumPy. It imports nothing of the port and reads nothing the port
made; ``compare`` decides whether a served answer says what the reference
says."""
