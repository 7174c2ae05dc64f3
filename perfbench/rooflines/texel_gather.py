"""The texel gather at given shapes: for B envs, every one of the P
pixels of the camera-frame planes looks up the nearest texel of its env's
track texture (uint8) and writes it as int32, as
`render/cuda_sampler.py::sample_banked` takes it.

No operations are counted. Bytes: the P texels the pixels need (one byte
each), the output (four bytes a pixel), the two pixel planes (P float32
each) and each env's camera (cos, sin, a 2-vector position, float32) and
track id (int32), each read or written once. The kernel
(`texel_gather.*.names`) takes every call on the card, one launch a call.
"""

ENTRY = "state_policy_diffusionmodel_torch.render.cuda_sampler:sample_banked"
KERNELS_A_CALL = 1


def describe(tex_bank, track_ids, cos_a, sin_a, pos, rx, ry):
    return {"B": int(track_ids.shape[0]), "P": int(rx.numel()),
            "cuda": bool(tex_bank.is_cuda)}


def takes(call) -> bool:
    return call["cuda"]


def work(call):
    B, P = call["B"], call["P"]
    nbytes = B * P * (1 + 4) + 2 * P * 4 + B * (4 + 4 + 8 + 4)
    return 0, nbytes, "fp32"
