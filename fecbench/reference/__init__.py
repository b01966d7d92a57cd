"""The benchmark's plain references: RS and LDPC encode and decode and the
stream framing in plain PyTorch and NumPy, worked out from each
configuration's file.  Nothing here imports the program under test."""
