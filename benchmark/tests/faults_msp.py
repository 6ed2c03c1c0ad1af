"""Faults planted underneath a run of the multislice-ptychography cell,
one function each; the harness calls the one a test names first
(``opts["patch"]``)."""


def update_not_applied():
    """Each step computes its gradients and moments and leaves the
    parameters as they were."""
    from pyslice_tpu_torch.analysis import ptychography

    def step(self, idx):
        val, _ = self.grads(idx)
        return val
    ptychography._MspRun.step = step


def half_minibatch():
    """The loss takes the first half of the minibatch's patterns."""
    from pyslice_tpu_torch.analysis import ptychography
    inner = ptychography._msp_loss

    def loss(v, modes, pos_b, a_b, *args, **kw):
        h = max(1, len(pos_b) // 2)
        return inner(v, modes, pos_b[:h], a_b[:h], *args, **kw)
    ptychography._msp_loss = loss


def last_mode_dropped():
    """The detector sum leaves out the last probe mode."""
    from pyslice_tpu_torch.analysis import ptychography
    inner = ptychography._msp_loss

    def loss(v, modes, *args, **kw):
        return inner(v, modes[:-1], *args, **kw)
    ptychography._msp_loss = loss


def adjoint_v_grad_high():
    """The adjoint's potential gradient comes out 1% too large."""
    from pyslice_tpu_torch.physics import adjoint
    inner = adjoint._backward

    def backward(*args, **kw):
        psi_grad, v_grad = inner(*args, **kw)
        return psi_grad, v_grad * 1.01
    adjoint._backward = backward


def positions_not_updated():
    """Each step leaves the scan positions where they were (their Adam
    moments still advance)."""
    from pyslice_tpu_torch.analysis import ptychography
    inner = ptychography._MspRun.step

    def step(self, idx):
        pos = self.pos
        val = inner(self, idx)
        self.pos = pos
        return val
    ptychography._MspRun.step = step


def amplitudes_not_rooted():
    """The ingest hands the intensities on as the amplitudes (no square
    root), on the host and on a card."""
    import numpy as np
    from pyslice_tpu_torch.analysis import ptychography

    def host(data4d):
        return np.maximum(np.fft.ifftshift(np.asarray(data4d),
                                           axes=(-2, -1)), 0.0)

    def card(blk):
        return ptychography.torch.fft.ifftshift(blk, dim=(-2, -1)).clamp(
            min=0.0)
    ptychography._detector_amplitudes = host
    ptychography._amplitudes_torch = card
