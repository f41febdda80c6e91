"""The one static analysis the emulator's flow pruning needs."""
