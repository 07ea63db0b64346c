"""Operations, bytes and the roofline bound, computed from shapes.

`peaks` holds the card's published peaks; `ivf` counts what the engine's
retrieval needs; `lm` counts the LM's FLOPs per token. Each count is what
the inputs need: every input byte read once, every output byte written
once, and only the rows that hold data (a bucket's filled rows, an
annex's valid ones), whatever the kernels read again.
"""
