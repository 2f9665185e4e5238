"""The early-stopping fit loop (a copy of the JAX package's
``earlystopping/trainer.py``, over the port's nets).

The loop: per epoch, fit every minibatch (checking iteration conditions on the
minibatch score), then every ``evaluate_every_n_epochs`` compute the
validation score, track/save the best model, and check epoch conditions.
"""

from __future__ import annotations

import math

from deeplearning4j_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    TerminationReason,
)


class EarlyStoppingListener:
    """reference: earlystopping/listener/EarlyStoppingListener.java"""

    def on_start(self, config, net) -> None:
        pass

    def on_epoch(self, epoch: int, score: float, config, net) -> None:
        pass

    def on_completion(self, result) -> None:
        pass


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator,
                 listener: EarlyStoppingListener | None = None,
                 health_guard=None):
        self.config = config
        self.net = net
        self.iterator = train_iterator
        self.listener = listener
        # health guard OFF by default here, unlike net.fit: this loop calls
        # fit() once per minibatch (a fresh default policy each call would
        # be stateless), and early stopping has its own divergence handling
        # — InvalidScoreIterationTerminationCondition terminates the run on
        # the raw NaN/inf score the guard deliberately leaves visible. Pass
        # a configured optimize.health.HealthPolicy to enable skip-step
        # protection under early stopping (one policy, carried across the
        # per-minibatch fit calls).
        self.health_guard = health_guard

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        if self.listener:
            self.listener.on_start(cfg, self.net)

        score_vs_epoch: dict = {}
        best_score = math.inf
        best_epoch = -1
        epoch = 0
        while True:
            if hasattr(self.iterator, "reset"):
                self.iterator.reset()
            terminate_reason = None
            try:
                for ds in self.iterator:
                    self.net.fit(ds, health_guard=self.health_guard)
                    last = self.net.score_value
                    for c in cfg.iteration_termination_conditions:
                        if c.terminate(last):
                            terminate_reason = c
                            break
                    if terminate_reason is not None:
                        break
            except Exception as e:  # noqa: BLE001 — reference returns Error result
                result = EarlyStoppingResult(
                    TerminationReason.ERROR, repr(e), score_vs_epoch,
                    best_epoch, best_score, epoch,
                    cfg.model_saver.get_best_model())
                if self.listener:
                    self.listener.on_completion(result)
                return result

            if terminate_reason is not None:
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.net, 0.0)
                result = EarlyStoppingResult(
                    TerminationReason.ITERATION_TERMINATION_CONDITION,
                    str(terminate_reason), score_vs_epoch, best_epoch,
                    best_score, epoch, cfg.model_saver.get_best_model())
                if self.listener:
                    self.listener.on_completion(result)
                return result

            epoch += 1
            if (epoch - 1) % cfg.evaluate_every_n_epochs == 0 or epoch == 1:
                sc = cfg.score_calculator
                score = 0.0 if sc is None else sc.calculate_score(self.net)
                score_vs_epoch[epoch - 1] = score
                if sc is not None and score < best_score:
                    best_score = score
                    best_epoch = epoch - 1  # 0-based, keys score_vs_epoch
                    cfg.model_saver.save_best_model(self.net, score)
                if self.listener:
                    self.listener.on_epoch(epoch, score, cfg, self.net)
                epoch_term = None
                for c in cfg.epoch_termination_conditions:
                    if c.terminate(epoch - 1, score):
                        epoch_term = c
                        break
                if epoch_term is not None:
                    if cfg.save_last_model:
                        cfg.model_saver.save_latest_model(self.net, score)
                    best = cfg.model_saver.get_best_model()
                    result = EarlyStoppingResult(
                        TerminationReason.EPOCH_TERMINATION_CONDITION,
                        str(epoch_term), score_vs_epoch, best_epoch,
                        best_score, epoch,
                        best if best is not None else self.net)
                    if self.listener:
                        self.listener.on_completion(result)
                    return result


# Graph nets share the same contract; alias for reference-API parity
# (reference: trainer/EarlyStoppingGraphTrainer.java).
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
