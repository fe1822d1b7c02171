"""Device selection shared by every entry point of the port."""
import torch


def resolve_device(device=None):
    """The torch.device an entry point runs on.

    None means the card: 'cuda' when one is present, else RuntimeError.
    Nothing silently carries on on the CPU; callers that want the CPU (the
    tests) pass device='cpu' explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device('cuda')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
