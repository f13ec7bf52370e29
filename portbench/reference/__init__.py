"""The plain reference: VoGE's render, the cameras and the two kinds of
call (fit, score) in plain PyTorch, importing nothing of the program."""
