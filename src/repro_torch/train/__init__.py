"""Training: AdamW, the train state and the step / loop drivers."""
