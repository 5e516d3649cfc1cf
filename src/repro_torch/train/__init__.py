"""Training and serving steps (port of `repro.train`). Only the serving
steps are ported; training, its optimizer, data and checkpoints wait
(ROADMAP Queue 1 item 11)."""
