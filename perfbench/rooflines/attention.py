"""Attention at given shapes: per head softmax(q k^T / sqrt(Dh)) v over
packed (B, T, heads * Dh) q, k, v, as `models/cuda_ops.py::attention_core`
takes them.

Operations: the two products, 2 * B * heads * T * T * Dh each (the
softmax's exponentials and sums are left out). Bytes: q, k and v read
once and the output written once, in the call's dtype. The unit: fp32
calls run on the fp32 pipes (K1 computes fp32 on register tiles), bf16
calls on the tensor cores. The kernels (`attention.*.names`) take the
calls with T >= 16 and Dh >= 8 on the card, one launch a call; the
others run as plain PyTorch and are not this roofline's.
"""

ENTRY = "state_policy_diffusionmodel_torch.models.cuda_ops:attention_core"
KERNELS_A_CALL = 1
_UNIT = {"float32": "fp32", "bfloat16": "bf16"}
_SIZE = {"float32": 4, "bfloat16": 2}


def describe(q, k, v, num_heads=1):
    B, T, C = q.shape
    return {"B": int(B), "T": int(T), "C": int(C), "heads": int(num_heads),
            "dtype": str(q.dtype).split(".")[-1],
            "cuda": bool(q.is_cuda)}


def takes(call) -> bool:
    return call["cuda"] and call["T"] >= 16 and \
        call["C"] // call["heads"] >= 8


def work(call):
    """(operations, bytes, the unit's peak name)."""
    B, T, C = call["B"], call["T"], call["C"]
    flops = 4 * B * T * T * C            # heads * Dh = C
    nbytes = 4 * B * T * C * _SIZE[call["dtype"]]
    return flops, nbytes, _UNIT[call["dtype"]]
