"""Model modules of the port (HuBERT, the parallel branch, SpeechCLIP)."""
