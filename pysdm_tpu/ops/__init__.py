"""vectorized/XLA kernel layer (the equivalent of the reference's backend
methods classes); the hand-written GPU kernel lives in ops/pallas/"""
