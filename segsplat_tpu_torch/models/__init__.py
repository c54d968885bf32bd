"""The CLIP text tower, LSeg and the CLIP tokenizer in torch.nn."""
